"""The port's CUDA kernels against their plain PyTorch versions, bitwise.

Marked ``gpu``: a CUDA kernel has no CPU mode, so these tests skip without
a card.  The file imports no JAX, so it also runs where only PyTorch is
installed; ``tests/conftest.py`` imports JAX, so run it there with

    PYTHONPATH=src python -m pytest -q --noconftest -m gpu \\
        tests/test_torch_kernels_cuda.py
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import comms as kern  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402

COLS = (1, 255, 256, 257, 2120, 2123)   # 2123: rows misaligned for float4
BLOCKS = (64, 256, 100)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def _payload(seed: int, rows: int, cols: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(rows, cols))
         * np.logspace(-3, 1, rows)[:, None]).astype(np.float32)
    x[-1] = 0.0
    return x


@pytest.mark.gpu
@pytest.mark.parametrize("block", BLOCKS)
@pytest.mark.parametrize("cols", COLS)
def test_kernels_match_plain_versions(cuda, cols, block):
    x = torch.from_numpy(_payload(cols + block, 6, cols)).to(cuda)
    kern.reset_launch_counts()
    q, s = kern.int8_quantize(x, block=block)
    y = kern.int8_dequantize(q, s, block=block)
    group = s.amax(0, keepdim=True).expand_as(s).contiguous()
    group[-2] *= 0.5                                  # saturates at +-127
    g = kern.int8_scale_quantize(x, group, block=block)
    torch.cuda.synchronize()
    q_p, s_p, _ = ref.int8_ref(x, block)
    assert torch.equal(q, q_p) and torch.equal(s, s_p)
    assert torch.equal(y, ref.int8_dequant_ref(q, s, block))
    assert torch.equal(g, ref.int8_scale_quant_ref(x, group, block))
    assert kern.launch_counts == {"int8_quantize": 1, "int8_dequantize": 1,
                                  "int8_scale_quantize": 1}


@pytest.mark.gpu
def test_kernels_refuse_mixed_devices(cuda):
    x = torch.zeros((2, 300), device=cuda)
    with pytest.raises(ValueError, match="different devices"):
        kern.int8_scale_quantize(x, torch.zeros((2, 2)))
