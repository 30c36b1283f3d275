"""The port's copies of configs and data yield what the reference yields:
equal configs and byte-identical batches from one seed."""
import dataclasses

import pytest

pytest.importorskip("torch")

import repro.configs as jcfg
import repro.data as jdata
import repro.data.partition as jpart
import repro.types as jtypes
import repro_torch.configs as tcfg
import repro_torch.data as tdata
import repro_torch.types as ttypes


@pytest.mark.parametrize("name", ["resnet3d-18", "resnet3d-26",
                                  "resnet3d-34", "llama4-scout-17b-a16e",
                                  "grok-1-314b", "seamless-m4t-large-v2",
                                  "internlm2-20b", "minitron-4b",
                                  "h2o-danube-3-4b", "paligemma-3b"])
def test_configs_equal(name):
    a, b = jcfg.get_config(name), tcfg.get_config(name)
    assert dataclasses.asdict(a) == dataclasses.asdict(b)
    assert dataclasses.asdict(a.reduced()) == dataclasses.asdict(b.reduced())


def test_fed_and_distill_config_defaults_equal():
    for a, b in ((jtypes.FedConfig(), ttypes.FedConfig()),
                 (jtypes.DistillConfig(), ttypes.DistillConfig())):
        assert dataclasses.asdict(a) == dataclasses.asdict(b)


def _assert_batches_equal(xs, ys):
    xs, ys = list(xs), list(ys)
    assert len(xs) == len(ys) > 0
    for x, y in zip(xs, ys):
        assert x.keys() == y.keys()
        for k in x:
            assert x[k].dtype == y[k].dtype and x[k].shape == y[k].shape
            assert x[k].tobytes() == y[k].tobytes(), k


@pytest.mark.parametrize("small", [True, False])
def test_make_dataset_for_and_loader_byte_identical(small):
    cfg = jcfg.get_config("resnet3d-18").reduced()
    ja = jdata.make_dataset_for(cfg, small=small, seed=3)
    ta = tdata.make_dataset_for(tcfg.get_config("resnet3d-18").reduced(),
                                small=small, seed=3)
    assert len(ja) == len(ta)
    for attr in ("dirs", "speeds", "widths", "textures"):
        assert getattr(ja, attr).tobytes() == getattr(ta, attr).tobytes()
    jp = jdata.iid_partition(len(ja), 3, seed=5)
    tp = tdata.iid_partition(len(ta), 3, seed=5)
    assert [p.tobytes() for p in jp] == [p.tobytes() for p in tp]
    for indices in (None, jp[1]):
        jl = jdata.BatchLoader(ja, 2, steps=3, seed=7, indices=indices)
        tl = tdata.BatchLoader(ta, 2, steps=3, seed=7, indices=indices)
        for _ in range(2):                 # each call is a new local epoch
            _assert_batches_equal(jl(), tl())
    _assert_batches_equal(
        [jdata.stack_batches(ja.batches(2, 3, seed=1), limit=2)],
        [tdata.stack_batches(ta.batches(2, 3, seed=1), limit=2)])
    assert tdata.stack_batches(iter([])) is None


def test_paper_clip_shape_batches_byte_identical():
    ja = jdata.SyntheticActionDataset(num_classes=400, samples_per_class=1,
                                      frames=8, size=112, seed=0)
    ta = tdata.SyntheticActionDataset(num_classes=400, samples_per_class=1,
                                      frames=8, size=112, seed=0)
    _assert_batches_equal(ja.batches(2, 1, seed=0), ta.batches(2, 1, seed=0))


@pytest.mark.parametrize("n,k", [(64, 4), (37, 5), (8, 8)])
def test_iid_partition_equal(n, k):
    for a, b in zip(jdata.iid_partition(n, k, seed=2),
                    tdata.iid_partition(n, k, seed=2)):
        assert a.tobytes() == b.tobytes()


@pytest.mark.parametrize("n,k", [(64, 4), (37, 5), (8, 8)])
def test_iid_shard_equal_to_reference_and_partition(n, k):
    """One client's shard, as the reference draws it and as the whole
    partition's k-th list, byte for byte (and with a shared permutation)."""
    import numpy as np
    perm = np.random.default_rng(2).permutation(n)
    for c in range(k):
        got = tdata.iid_shard(n, k, c, seed=2)
        assert got.tobytes() == jpart.iid_shard(n, k, c, seed=2).tobytes()
        assert got.tobytes() == tdata.iid_partition(n, k, seed=2)[c].tobytes()
        assert tdata.iid_shard(n, k, c, perm=perm).tobytes() == got.tobytes()
    with pytest.raises(ValueError, match="outside"):
        tdata.iid_shard(n, k, k)


@pytest.mark.parametrize("alpha,clients", [(0.5, 4), (0.1, 3), (100.0, 6)])
def test_dirichlet_partition_equal(alpha, clients):
    """The non-IID split the algorithm tests draw, byte for byte."""
    import numpy as np
    labels = np.random.default_rng(1).integers(0, 8, 200)
    got = tdata.dirichlet_partition(labels, clients, alpha=alpha, seed=4)
    want = jdata.dirichlet_partition(labels, clients, alpha=alpha, seed=4)
    assert [p.tobytes() for p in got] == [p.tobytes() for p in want]
    assert sorted(np.concatenate(got).tolist()) == list(range(200))
