"""The port's MoE layer (``repro_torch/models/moe.py``) against the
reference's on the same numpy inputs and JAX-initialised weights: the
routing first (expert indices, ``keep``, ``slot``, ``frac``, ``mean_p``,
the renormalised weights), at a capacity that drops picks and dropless,
the lower index first on tied router probabilities; then ``moe_forward``'s
output and aux loss within 1e-5 relative, top-1 with a shared expert
(llama4-scout's structure) and top-2 without (grok-1's); the gradients
through the dispatch and combine within 1e-5; the capacity formula at
the full configs; and ``moe_ctx``'s distributed dispatch in a world of
one (one dp shard), equal to the local path."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro.models import moe as jmoe
from repro.types import MoEConfig as JMoE
from repro_torch import configs as tcfg
from repro_torch.models import moe as tmoe
from repro_torch.types import MoEConfig as TMoE

D, F = 32, 48
# (experts, top_k, shared expert): llama4-scout's and grok-1's structure
STRUCTS = {"top1_shared": (4, 1, True), "top2": (4, 2, False),
           "top2_e8": (8, 2, False)}


def _cfgs(struct, capacity_factor=1.25):
    E, k, shared = STRUCTS[struct]
    kw = dict(num_experts=E, top_k=k, shared_expert=shared,
              capacity_factor=capacity_factor, router_aux_weight=0.01)
    return JMoE(**kw), TMoE(**kw)


def _params(jc, seed=0):
    """Layer 0 of the reference's init: (the JAX dict, the torch dict)."""
    stacked = jmoe.init_moe_params(jax.random.PRNGKey(seed), D, F, jc, 1)
    jp = {k: v[0] for k, v in stacked.items()}
    return jp, {k: torch.tensor(np.asarray(v)) for k, v in jp.items()}


def _x(rng, B=2, S=24):
    return rng.standard_normal((B, S, D)).astype(np.float32)


def _rel_close(got, want, rtol=1e-5):
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * max(1.0, np.abs(want).max()))


@pytest.mark.parametrize("C", [5, None])      # None: dropless, C = T
@pytest.mark.parametrize("struct", sorted(STRUCTS))
def test_routing_equals_reference(struct, C, rng):
    jc, tc = _cfgs(struct)
    jp, tp = _params(jc, seed=1)
    xt = _x(rng).reshape(-1, D)
    C = C or xt.shape[0]
    jw, jslot, jkeep, jfrac, jmean = jmoe._route(jp["router"],
                                                 jnp.asarray(xt), jc, C)
    jprobs = jax.nn.softmax(jnp.asarray(xt) @ jp["router"], axis=-1)
    _, jidx = jax.lax.top_k(jprobs, jc.top_k)
    tw, tslot, tkeep, tfrac, tmean, tidx = tmoe.route(
        tp["router"], torch.tensor(xt), tc, C)
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(tkeep.numpy(), np.asarray(jkeep))
    np.testing.assert_array_equal(tslot.numpy(), np.asarray(jslot))
    _rel_close(tfrac.numpy(), jfrac)     # a mean: the division may round
    _rel_close(tmean.numpy(), jmean)
    _rel_close(tw.numpy(), jw)
    if C < xt.shape[0] * jc.top_k / jc.num_experts:
        assert not tkeep.all()           # this capacity drops picks
    if C == xt.shape[0]:
        assert tkeep.all()               # dropless keeps every pick


def test_tied_router_probabilities_pick_the_lower_index():
    """A zero router gives every expert the same probability: top-k takes
    experts 0 .. k-1 in order, as ``jax.lax.top_k`` does."""
    jc, tc = _cfgs("top2_e8")
    xt = np.ones((6, D), np.float32)
    router = np.zeros((D, 8), np.float32)
    router[:, 5] = router[:, 6] = 0.25         # a tie at the top, too
    for r in (np.zeros_like(router), router):
        *_, idx = tmoe.route(torch.tensor(r), torch.tensor(xt), tc, 6)
        probs = jax.nn.softmax(jnp.asarray(xt) @ jnp.asarray(r), axis=-1)
        np.testing.assert_array_equal(
            idx.numpy(), np.asarray(jax.lax.top_k(probs, 2)[1]))
    assert idx[:, 0].tolist() == [5] * 6 and idx[:, 1].tolist() == [6] * 6


@pytest.mark.parametrize("dropless", [False, True])
@pytest.mark.parametrize("struct", ["top1_shared", "top2"])
def test_moe_forward_and_aux_match_reference(struct, dropless, rng):
    jc, tc = _cfgs(struct)
    jp, tp = _params(jc, seed=2)
    x = _x(rng)
    for act in ("silu", "gelu"):
        jout, jaux = jmoe.moe_forward(jp, jnp.asarray(x), jc, act,
                                      dropless=dropless)
        tout, taux = tmoe.moe_forward(tp, torch.tensor(x), tc, act,
                                      dropless=dropless)
        assert tout.shape == x.shape and taux.dtype == torch.float32
        _rel_close(tout.numpy(), jout)
        assert abs(float(taux) - float(jaux)) <= 1e-5 * abs(float(jaux))


def test_dropped_tokens_get_only_the_shared_expert(rng):
    """At capacity 1 of 48 tokens almost every pick drops: the reference
    and the port agree, and a token whose pick dropped gets the shared
    expert's output alone."""
    jc, tc = _cfgs("top1_shared", capacity_factor=1 / 12)
    jp, tp = _params(jc, seed=3)
    x = _x(rng)
    assert tmoe.capacity(48, tc) == 1
    jout, _ = jmoe.moe_forward(jp, jnp.asarray(x), jc)
    tout, _ = tmoe.moe_forward(tp, torch.tensor(x), tc)
    _rel_close(tout.numpy(), jout)
    keep = tmoe.route(tp["router"], torch.tensor(x).reshape(-1, D), tc,
                      1)[2]
    dropped = (~keep).nonzero()[0, 0]
    xt = torch.tensor(x).reshape(-1, D)[dropped]
    act = torch.nn.functional.silu
    shared = (act(xt @ tp["shared_wg"]) * (xt @ tp["shared_wi"])) \
        @ tp["shared_wo"]
    torch.testing.assert_close(tout.reshape(-1, D)[dropped], shared)


@pytest.mark.parametrize("struct", ["top1_shared", "top2"])
def test_gradients_through_dispatch_match_reference(struct, rng):
    """d(sum(out * g) + aux) by every weight and by x, capacity routing
    that drops picks, against ``jax.grad``."""
    jc, tc = _cfgs(struct, capacity_factor=0.5)
    jp, tp = _params(jc, seed=4)
    x, g = _x(rng), _x(rng)

    def jloss(p, x):
        out, aux = jmoe.moe_forward(p, x, jc)
        return jnp.sum(out * jnp.asarray(g)) + aux

    jgp, jgx = jax.grad(jloss, argnums=(0, 1))(jp, jnp.asarray(x))
    tp = {k: v.clone().requires_grad_(True) for k, v in tp.items()}
    tx = torch.tensor(x, requires_grad=True)
    out, aux = tmoe.moe_forward(tp, tx, tc)
    (torch.sum(out * torch.tensor(g)) + aux).backward()
    _rel_close(tx.grad.numpy(), jgx)
    for k, v in jgp.items():
        _rel_close(tp[k].grad.numpy(), v)


@pytest.mark.parametrize("arch,T,want", [
    ("llama4-scout-17b-a16e", 2048, 160), ("grok-1-314b", 2048, 640),
    ("llama4-scout-17b-a16e", 7, 1)])
def test_capacity_matches_reference(arch, T, want):
    moe = tcfg.get_config(arch).moe
    jc = JMoE(**dataclasses.asdict(moe))
    assert tmoe.capacity(T, moe) == jmoe.capacity(T, jc) == want


def test_moe_ctx_raises_naming_item_13(rng):
    """``moe_ctx`` on the (1, 1) host mesh: one dp shard routes every
    token with the whole batch's capacity, so the output and aux equal
    the local path's bit for bit, with ``"model"`` in dp too
    (``moe_fullgrid``); a dp without the mesh's data axes raises."""
    from repro_torch.launch.mesh import make_host_mesh
    mesh = make_host_mesh(device="cpu")
    _, tc = _cfgs("top2")
    _, tp = _params(_cfgs("top2")[0])
    x = torch.tensor(_x(rng))
    want = tmoe.moe_forward(tp, x, tc)
    for dp in ("data", ("data", "model")):
        got = tmoe.moe_forward(tp, x, tc, moe_ctx={"mesh": mesh, "dp": dp})
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    with pytest.raises(ValueError, match="data axes"):
        tmoe.moe_forward(tp, x, tc, moe_ctx={"mesh": mesh, "dp": "model"})


SPAWN_LIMIT_S = 120


def _all_to_all_rank(rank: int, store: str, out: str):
    import datetime
    import json
    from pathlib import Path

    import torch.distributed as dist
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.sharding import specs as shspecs
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, 2),
                            rank=rank, world_size=2,
                            timeout=datetime.timedelta(seconds=60))
    mesh = make_mesh((1, 2), ("data", "model"), device="cpu")
    split = shspecs.MeshSplit(mesh, {}, {}, seq=False)
    got = {}
    for dt in (torch.float32, torch.bfloat16):
        rng = [np.random.default_rng(10 * r + 1) for r in range(2)]
        xs = [torch.tensor(g.standard_normal((4, 3, 5)), dtype=dt)
              for g in rng]                   # every rank's input
        ws = [torch.tensor(g.standard_normal((4, 3, 5)), dtype=dt)
              for g in rng]                   # every rank's d loss / d out
        x = xs[rank].clone().requires_grad_()
        y = split.exchange(x)
        (y.float() * ws[rank].float()).sum().backward()
        # rank r receives block r of every rank, in the senders' order;
        # block j of its input's gradient is rank j's at block r
        want = torch.cat([xs[s][2 * rank:2 * rank + 2] for s in range(2)])
        grad = torch.cat([ws[j][2 * rank:2 * rank + 2] for j in range(2)])
        got[str(dt)] = {"dtype": str(y.dtype),
                        "fwd": float((y - want).abs().max()),
                        "bwd": float((x.grad - grad).abs().max())}
    try:
        split.exchange(torch.zeros(3, 2))
        got["odd"] = "no error"
    except ValueError as e:
        got["odd"] = str(e)
    Path(out, f"rank{rank}.json").write_text(json.dumps(got))
    dist.destroy_process_group()


def test_all_to_all_matches_a_gather_and_slice(tmp_path):
    """``MeshSplit.exchange`` (``sharding.specs._AllToAll``) on 2 gloo
    ranks, f32 and bf16: its forward equal to every rank's input gathered
    and the rank's block of each sliced out, its backward to the inverse
    exchange of the output's gradient, exactly, in the input's dtype; a
    dim 0 the ranks do not divide raises."""
    import json
    import time

    import torch.multiprocessing as mp
    ctx = mp.spawn(_all_to_all_rank,
                   args=(str(tmp_path / "store"), str(tmp_path)),
                   nprocs=2, join=False)
    deadline = time.monotonic() + SPAWN_LIMIT_S
    while not ctx.join(timeout=5):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            pytest.fail(f"2 ranks did not finish in {SPAWN_LIMIT_S} s")
    for r in range(2):
        got = json.loads((tmp_path / f"rank{r}.json").read_text())
        assert "does not split" in got.pop("odd"), got
        for dt, row in got.items():
            assert row["dtype"] == dt and row["fwd"] == 0.0 and \
                row["bwd"] == 0.0, (r, got)
