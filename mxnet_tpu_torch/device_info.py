"""Device capability table (dense bf16 peak FLOP/s) for MFU accounting.

Counterpart of ``mxnet_tpu/device_info.py``, which keys its TPU figures on
``device_kind``; here the key is the card's name as
``torch.cuda.get_device_name`` gives it. The figures are NVIDIA's H100
Tensor Core GPU data sheet, bf16 on the tensor cores without sparsity
(half the sheet's "with sparsity" figure), at each form factor's full
power limit. Used by ``callback.Speedometer``'s MFU display.
"""
__all__ = ["bf16_peak_flops"]

# NVIDIA H100 data sheet, dense bf16 tensor-core peaks
_PEAK = {
    "NVIDIA H100 80GB HBM3": 989.4e12,  # H100 SXM5
    "NVIDIA H100 PCIe": 756.5e12,
    "NVIDIA H100 NVL": 835.5e12,
}


def bf16_peak_flops(device_kind):
    """Dense bf16 peak for a card name, tolerant of suffixes ("NVIDIA H100
    PCIe 80GB" → "NVIDIA H100 PCIe"); None when unknown: callers must not
    guess."""
    if device_kind in _PEAK:
        return _PEAK[device_kind]
    best = None
    for kind, peak in _PEAK.items():
        if device_kind.startswith(kind):
            if best is None or len(kind) > len(best[0]):
                best = (kind, peak)
    return best[1] if best else None
