"""Published peaks of the cards the benchmark runs on (NVIDIA's data
sheets, dense rates without sparsity), by the name
``torch.cuda.get_device_name()`` gives. Rates assume the card's full
power limit; a run records the card's name beside its numbers."""
from __future__ import annotations

PEAKS = {
    # H100 SXM5: 989 TFLOP/s bf16, 495 TF32, 67 fp32 off the tensor
    # cores, 3.35 TB/s of HBM3
    "NVIDIA H100 80GB HBM3": {"tf32_flops": 495e12, "fp32_flops": 67e12,
                              "bf16_flops": 989e12, "hbm_bytes": 3.35e12},
}


def peaks(device_name: str) -> dict:
    """The peaks of ``device_name``; a card the table lacks has none, and
    the shares that need them are left out."""
    return PEAKS.get(device_name, {})
