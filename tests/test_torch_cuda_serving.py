"""Serving's decode as CUDA graphs on the card: the continuous batcher's
ticks replayed from ``GraphCache`` graphs that read the params and write
the cache in place, and the static decode's steps (``serve.greedy_step``)
replayed the same way, each held against the eager decode on an identical
copy of the cache, bit for bit with TF32 off and cuDNN deterministic; a
replay with host syncs made errors; captures bounded by the K-extent
ladder. Needs an NVIDIA GPU and nvcc; elsewhere every test skips with a
reason. Imports no JAX:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda_serving.py
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config
from repro_torch.core.compile_cache import GraphCache
from repro_torch.core.serving import ContinuousBatcher
from repro_torch.kernels import decode_attend as da
from repro_torch.kernels import ssd_decode as sd
from repro_torch.launch import serve
from repro_torch.models import registry
from repro_torch.types import ShapeConfig

pytestmark = pytest.mark.cuda

TICKS = 12      # from position 6: the K-extent rungs 8, 16 and 32


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: a CUDA kernel has no CPU mode")
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32,
             torch.backends.cudnn.deterministic)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    yield torch.device("cuda")
    (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
     torch.backends.cudnn.deterministic) = flags


def _launches() -> tuple:
    return (da.ring_decode_attend.launches, da.extent_decode_attend.launches,
            sd.ssd_decode_step.launches)


def _params(arch, device):
    cfg = get_config(arch).reduced()
    cpu = registry.init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    return cfg, {k: v.to(device) for k, v in cpu.items()}


def _admitted(arch, mode, device):
    """A batcher on the card that has admitted two prompts (6 and 3
    tokens) and decoded nothing yet."""
    cfg, params = _params(arch, device)
    srv = ContinuousBatcher(params, cfg, max_slots=2, max_len=64,
                            min_bucket=4, decode_mode=mode)
    rng = np.random.default_rng(1)
    for n in (6, 3):
        srv.submit(rng.integers(0, cfg.vocab_size, n), max_new=40)
    srv._admit()
    return srv


def _equal(a: dict, b: dict) -> bool:
    return a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)


@pytest.mark.parametrize("arch,mode", [
    ("hymba-1.5b", "ring"), ("hymba-1.5b", "uniform"),
    ("mamba2-130m", "ring"), ("gemma3-12b", "ring"),
    ("llama4-scout-17b-a16e", "ring")])
def test_captured_ticks_equal_eager_ticks(cuda, arch, mode):
    """Each tick through the batcher's graphs (a rung's first eager, its
    second captured, later ones replayed) against the eager decode on a
    copy of the cache: logits, tokens and every cache leaf 0.0 apart.
    One graph a rung reached, never more than the ladder's length."""
    srv = _admitted(arch, mode, cuda)
    twin = {k: v.clone() for k, v in srv.cache.items()}
    mask = np.ones(srv.max_slots, bool)
    for t in range(TICKS):
        tp = torch.from_numpy(np.stack([srv.last_tok, srv.pos])).to(cuda)
        if mode == "ring":
            want, twin = registry.decode_step_grouped(
                srv.params, srv.cfg, tp[0], twin, tp[1],
                k_ext=srv._decode_k_ext(mask),
                decode_kernel=srv.decode_kernel)
        else:
            want, twin = registry.decode_step(srv.params, srv.cfg, tp[0],
                                              twin, tp[1])
        tok, logits = srv._decode(mask)
        assert torch.equal(logits, want), (arch, mode, t)
        assert torch.equal(tok, torch.argmax(want, dim=-1).to(torch.int32))
        assert _equal(srv.cache, twin), (arch, mode, t)
        srv.last_tok[:] = tok.cpu().numpy()
        srv.pos += 1
    rungs = len(srv.decode_buckets)
    assert srv.decode_compiles <= max(1, rungs)
    assert srv._graphs.num_captured == srv.decode_compiles
    if mode == "ring" and rungs:
        assert srv.decode_compiles == 3          # rungs 8, 16 and 32
        for r in srv.decode_buckets:
            assert srv._graphs.captures(("decode", r)) <= 1


def test_replay_makes_no_host_sync_and_no_host_launch(cuda):
    """A replayed tick under ``set_sync_debug_mode("error")`` raises
    nothing and adds nothing to the wrappers' counts; its eager tick and
    its capture add one launch of each kernel a layer each."""
    srv = _admitted("hymba-1.5b", "ring", cuda)
    mask = np.ones(srv.max_slots, bool)
    before = _launches()
    srv._decode(mask)                  # eager
    srv._decode(mask)                  # captured, then replayed
    assert srv._graphs.num_captured == 1
    per_tick = np.subtract(_launches(), before) // 2
    assert tuple(per_tick) == (1, 1, 2)   # one SWA and one global layer
    tp = torch.from_numpy(np.stack([srv.last_tok, srv.pos])).to(cuda)
    name, fn = srv._decode_entry(mask)
    before = _launches()
    torch.cuda.set_sync_debug_mode("error")
    try:
        tok, _, cache = srv._graphs.call(name, fn,
                                         (srv.params, tp, srv.cache),
                                         inplace=(0, 2))
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    assert _launches() == before
    assert srv._graphs.num_captured == 1
    assert all(cache[k] is srv.cache[k] for k in cache)
    assert tok.shape == (2,) and tok.dtype == torch.int32


def test_in_place_leaves_are_the_callers_and_key_the_graph(cuda):
    """``GraphCache``'s in-place leaves on the card: written where they
    live, handed back as themselves; another tensor there is another
    graph; a copied leaf's new values replay the same graph."""
    graphs = GraphCache()

    def fn(acc, x):
        acc.add_(x)
        return acc, x * 2

    acc = torch.zeros(4, device=cuda)
    for i in range(4):
        x = torch.full((4,), float(i), device=cuda)
        got, twice = graphs.call("f", fn, (acc, x), inplace=(0,))
        assert got is acc and torch.equal(twice, 2 * x)
    assert torch.equal(acc, torch.full((4,), 6.0, device=cuda))
    assert (graphs.num_compiled, graphs.num_captured) == (1, 1)
    other = torch.zeros(4, device=cuda)
    graphs.call("f", fn, (other, x), inplace=(0,))
    assert (graphs.num_compiled, graphs.num_captured) == (2, 1)
    assert torch.equal(other, x)


def _static(arch, device):
    """A reduced config's params on the card and a batch of two prompts
    of 6 tokens (a VLM's patch prefix too; an encoder-decoder's 6 source
    frames)."""
    cfg, params = _params(arch, device)
    P, B = 6, 2
    shape = ShapeConfig(name="serve", global_batch=B,
                        seq_len=P + cfg.prefix_len, kind="decode")
    batch = registry.synth_batch(np.random.default_rng(2), cfg, shape,
                                 device=device)
    return cfg, params, batch, P


@pytest.mark.parametrize("arch", ["hymba-1.5b", "mamba2-130m", "gemma3-12b",
                                  "llama4-scout-17b-a16e", "paligemma-3b",
                                  "seamless-m4t-large-v2"])
def test_static_decode_replays_equal_eager_steps(cuda, arch):
    """``generate``'s tokens on the card equal the eager steps'; each
    replayed ``greedy_step`` (params, cache, token and positions in place)
    against the eager step on copies: logits, cache and state 0.0."""
    cfg, params, batch, P = _static(arch, cuda)
    gen = 8
    toks, _, _ = serve.generate(params, cfg, batch, P + gen, gen)
    # the same prefill, then the steps eagerly and through a GraphCache
    if cfg.is_encdec:
        cache = registry.prefill(params, cfg, {"src_embeds":
                                               batch["src_embeds"]},
                                 registry.init_cache(cfg, 2, P + gen,
                                                     torch.float32, cuda))
        tok, start = torch.zeros(2, dtype=torch.int32, device=cuda), 0
    else:
        b = {k: v for k, v in batch.items() if k != "labels"}
        prefix = cfg.prefix_len if "prefix_embeds" in b else 0
        start = b["tokens"].shape[1] + prefix
        with torch.no_grad():
            logits, cache = registry.prefill(
                params, cfg, b, registry.init_cache(
                    cfg, 2, P + gen + prefix, torch.float32, cuda),
                q_chunk=start)
        tok = torch.argmax(logits, dim=-1).to(torch.int32)
    state = {"tok": tok.clone(),
             "pos": torch.full((2,), start, dtype=torch.int32, device=cuda)}
    twin = ({k: v.clone() for k, v in cache.items()},
            {k: v.clone() for k, v in state.items()})
    step = functools.partial(serve.greedy_step, cfg)
    graphs, eager = GraphCache(), [tok.cpu().numpy().copy()]
    with torch.no_grad():
        for _ in range(gen - 1):
            lg, cache, state = graphs.call("decode", step,
                                           (params, cache, state),
                                           inplace=(0, 1, 2))
            want, *twin = step(params, *twin)
            assert torch.equal(lg, want)
            assert _equal(cache, twin[0]) and _equal(state, twin[1])
            eager.append(twin[1]["tok"].cpu().numpy().copy())
    assert graphs.num_captured == 1
    np.testing.assert_array_equal(toks, np.stack(eager, axis=1))
