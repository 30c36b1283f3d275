"""Fused KD loss of the port vs the reference's Pallas kernel (interpret
mode) and its jnp oracle on bf16 logits, at the bf16 tolerance of
``tests/test_kernels.py``. The f32 cases are in ``test_torch_kd_loss.py``."""
import pytest

pytest.importorskip("torch")

from torch_parity import kd_sweep_case


@pytest.mark.parametrize("R,V", [(8, 512), (37, 1000), (3, 300), (4, 400)])
@pytest.mark.parametrize("dt", ["bf16"])
@pytest.mark.parametrize("alpha", [0.0, 0.5, 1.0])
def test_kd_loss_sweep(R, V, dt, alpha, rng):
    kd_sweep_case(R, V, dt, alpha, rng)
