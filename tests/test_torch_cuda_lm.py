"""The LM training slice on the card: kernels 1 and 1b (the KD loss's
forward and backward) at LM vocabularies, R = 256 rows of V = 50280
(Mamba2-130M, 16-byte rows) and V = 32001 (Hymba-1.5B, rows not aligned
for vectors: the strided forward), against their plain versions (see
``RTOL``); a reduced Mamba2 client round replayed as a CUDA graph
against its eager run, bit for bit (TF32 off, cuDNN deterministic); and
``launch.steps.make_train_step`` on the card against the CPU at f32
compute (TF32 off; losses 1e-5 relative, params 1e-5). Needs an NVIDIA
GPU and nvcc; elsewhere every test skips with a reason. Imports no JAX:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda_lm.py
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config
from repro_torch.core import fed_engine
from repro_torch.data import make_dataset_for, stack_batches
from repro_torch.kernels import kd_loss, ref
from repro_torch.launch import steps
from repro_torch.models import registry
from repro_torch.types import FedConfig

pytestmark = pytest.mark.cuda

# forward: |err| <= fwd * |plain| on live rows (masked rows exactly 0);
# backward: |err| <= bwd * (alpha |g (p - y)| + (1 - alpha) |2 g (s - t)|),
# elementwise, the size of ds's two terms (dt's: the second). ds is ~1/R,
# so a 1 + |plain| floor would pass any CE half. The limits are about 3x
# the largest errors measured on an H100 (1.6e-7 and 1.8e-6).
RTOL = {"fwd": 5e-7, "bwd": 5e-6}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    flags = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.deterministic)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    yield torch.device("cuda")
    (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cudnn.deterministic) = flags


def _assert_within(got, want, scale, rtol, what):
    """|got - want| <= rtol * scale elementwise; exact where scale is 0."""
    diff = (got.float() - want.float()).abs()
    ok = torch.where(scale > 0, diff <= rtol * scale, diff == 0)
    assert bool(ok.all()), (what, float(diff.max()))


@pytest.mark.parametrize("case", ["mixed", "ce", "near"])
@pytest.mark.parametrize("V", [50280, 32001])
def test_kd_kernels_at_lm_vocabularies(cuda, V, case):
    """mixed: independent logits, alpha 0.5, three rows masked, a row
    cotangent of stride 1; ce: alpha 1 (the CE half alone); near: the
    teacher the student plus 0.01 noise, alpha 0.5, so both halves of the
    loss are of one size. ce and near take no mask and the stride-0
    cotangent of a mean, as the KD epoch's call."""
    R = 256
    g = torch.Generator().manual_seed(V)
    s = torch.randn(R, V, generator=g).to(cuda)
    t = torch.randn(R, V, generator=g).to(cuda)
    lab = torch.randint(0, V, (R,), generator=g, dtype=torch.int32).to(cuda)
    alpha, valid = 0.5, None
    gr = torch.full((1,), 1.0 / R, device=cuda).expand(R)
    if case == "mixed":
        valid = torch.ones(R, device=cuda)
        valid[R - 3:] = 0.0
        gr = torch.full((R,), 1.0 / R, device=cuda)
    elif case == "ce":
        alpha = 1.0
    else:
        t = s + 0.01 * torch.randn(R, V, generator=g).to(cuda)
    got = kd_loss.kd_loss_fused(s, t, lab, alpha, 1.0, valid=valid)
    want = ref.kd_loss_ref(s, t, lab, alpha, 1.0, valid=valid)
    _assert_within(got, want, want.abs(), RTOL["fwd"], "forward")
    if valid is not None:
        assert torch.equal(got[R - 3:], torch.zeros(3, device=cuda))
    lse = torch.empty(R, device=cuda)
    kd_loss._fused_fwd(s, t, lab, alpha, 1.0, valid, lse)
    want_ds, want_dt = kd_loss.kd_loss_rows_bwd(s, t, lab, valid, gr, alpha,
                                                1.0)
    ce = kd_loss.kd_loss_rows_bwd(s, t, lab, valid, gr, 1.0, 1.0)[0].abs()
    sq = kd_loss.kd_loss_rows_bwd(s, t, lab, valid, gr, 0.0, 1.0)[0].abs()
    for need_dt in (True, False):
        ds, dt = kd_loss.kd_loss_fused_bwd(s, t, lab, valid, gr, lse, alpha,
                                           1.0, need_dt=need_dt)
        _assert_within(ds, want_ds, alpha * ce + (1 - alpha) * sq,
                       RTOL["bwd"], ("ds", need_dt))
        assert (dt is None) != need_dt
        if need_dt:
            _assert_within(dt, want_dt, (1 - alpha) * sq, RTOL["bwd"], "dt")


def _lm_round(device):
    cfg = get_config("mamba2-130m").reduced()
    fed = FedConfig(num_clients=2, local_iters_min=1, local_iters_max=2,
                    lr=0.01)
    params = registry.init_params(torch.Generator().manual_seed(0), cfg,
                                  device)
    ds = make_dataset_for(cfg, seed=1)
    stacks = [stack_batches(ds.batches(2, 2, seed=k)) for k in range(2)]
    padded, _ = fed_engine.pad_client_batches(stacks)
    return cfg, fed, params, padded


def test_lm_client_round_replay_equals_eager(cuda):
    cfg, fed, params, padded = _lm_round(cuda)
    run = fed_engine.ClientRun(cfg, fed)
    iters = np.asarray([2, 1], np.int32)
    outs = [run.run_batch(params, padded, iters) for _ in range(3)]
    assert run._graphs.num_captured == 1
    for w, losses in outs[1:]:            # the capture's run and a replay
        for k in outs[0][0]:
            assert torch.equal(w[k], outs[0][0][k]), k
        assert torch.equal(losses.nan_to_num(), outs[0][1].nan_to_num())


@pytest.mark.parametrize("arch", ["hymba-1.5b", "mamba2-130m"])
def test_train_step_card_vs_cpu(cuda, arch):
    cfg = get_config(arch).reduced()
    fed = FedConfig(lr=0.05)
    ds = make_dataset_for(cfg, seed=1)
    ds.seq_len = 32
    batches = list(ds.batches(2, 3, seed=0))
    out = {}
    for dev in ("cpu", cuda):
        params = registry.init_params(torch.Generator().manual_seed(0), cfg,
                                      "cpu")
        params = {k: v.to(dev) for k, v in params.items()}
        step, opt = steps.make_train_step(cfg, fed,
                                          loss_kwargs={"dtype": None})
        state, anchor, losses = opt.init(params), dict(params), []
        for b in batches:
            params, state, loss = step(params, state, anchor, b)
            losses.append(float(loss))
        out[str(dev)] = (params, np.array(losses))
    (pc, lc), (pg, lg) = out["cpu"], out[str(cuda)]
    np.testing.assert_allclose(lg, lc, rtol=1e-5)
    for k in pc:
        assert bool(((pg[k].cpu() - pc[k]).abs() <= 1e-5).all()), k
