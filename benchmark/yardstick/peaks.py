"""Published peaks of the cards the benchmark runs on (NVIDIA's data sheet,
SXM part, dense rates, at the full 700 W power limit).  ``f32_ops_nofma``
is the f32 peak halved: the selection kernels are built without fused
multiply-add, so each operation issues alone."""

from __future__ import annotations

from typing import Optional

PEAKS = {
    "H100": {
        "f32_flops": 67e12,
        "tf32_flops": 495e12,
        "bf16_flops": 989e12,
        "hbm_bytes_per_s": 3.35e12,
        "f32_ops_nofma": 33.5e12,
    },
}


def peaks_for(device_name: str) -> Optional[dict]:
    for key, peaks in PEAKS.items():
        if key in device_name:
            return peaks
    return None


def compute_peak(peaks: dict, dtype: str) -> float:
    """FLOP/s of the configuration's compute dtype (TF32 is off in the
    measured program, so float32 runs outside the tensor cores)."""
    return peaks["bf16_flops" if dtype == "bfloat16" else "f32_flops"]
