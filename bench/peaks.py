"""Published peaks of the cards the benchmark runs on (NVIDIA's data
sheet, H100 SXM, dense rates without sparsity, at the full 700 W power
limit). A metric states its share against these, with the card's power
limit printed beside it."""
from __future__ import annotations

PEAKS = {
    "H100": {"bf16_flops": 989e12, "f32_flops": 67e12,
             "hbm_bytes_per_s": 3.35e12},
}


def of(device_name: str) -> dict:
    """The peaks of the card named ``device_name`` (its
    ``torch.cuda.get_device_name``); a card not in the table has none."""
    for key, peaks in PEAKS.items():
        if key in device_name:
            return peaks
    raise ValueError(f"no published peaks for {device_name!r}")
