"""The port's quantizers on the card against numpy's ``amax / 127``.

``quantize_matrix``, ``quantize_activations`` and ``_quantize_kv`` divide
by a tensor of 127s, so on the card (where a division by a Python scalar
becomes a product by its reciprocal) they give numpy's f32 scales and
int8 codes bit for bit: 1000 x 4096 Gaussian rows, their bf16 roundings,
and rows of exact powers of two (``chip_smoke.check_quantizers``, which
the ``hf_checkpoint`` phase also runs).  Skips without a card; on one:

    python -m pytest --noconftest tests/test_torch_quant_cuda.py -q
"""

import pytest
import torch

from chip_smoke import check_quantizers

pytestmark = pytest.mark.cuda


def test_quantizers_equal_numpy_bit_for_bit_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the division under test is the card's")
    out = check_quantizers(torch, torch.device("cuda", 0))
    assert out["quantizers_bitwise_equal"]
    # The rows carry scales that a product by 1/127 would have moved.
    assert out["scales_a_reciprocal_would_move"]["gaussian"] > 0
