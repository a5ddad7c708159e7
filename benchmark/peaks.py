"""Published peaks of the cards the benchmark runs on.

NVIDIA H100 SXM data sheet, dense (no sparsity), at the full 700 W power
limit: bf16 / fp16 989 TFLOP/s on the tensor cores, fp8 and int8 1979,
TF32 495, float32 outside the tensor cores 67; 3.35 TB/s of HBM3. A card
the table does not name has no peak: the shares of a peak are then left
out of the result, never computed against a guess.
"""

from __future__ import annotations

from typing import Dict, Optional

PEAKS: Dict[str, Dict[str, float]] = {
    "NVIDIA H100 80GB HBM3": {
        "bf16_flops": 989e12, "fp8_flops": 1979e12, "int8_ops": 1979e12,
        "tf32_flops": 495e12, "fp32_flops": 67e12, "hbm_bytes": 3.35e12},
}


def peak(device_name: str, key: str) -> Optional[float]:
    """The peak of the card named exactly as torch.cuda.get_device_name
    gives it (the SXM part; a PCIe H100 has lower peaks), or None."""
    table = PEAKS.get(device_name)
    return None if table is None else table[key]
