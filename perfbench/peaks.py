"""Published peaks of the cards a run may report, by the name that
``torch.cuda.get_device_name()`` gives: dense FP32 operations a second
outside the tensor cores, and memory bytes a second.  A roofline share is
stated against these, at the card's full power limit."""

PEAKS = {
    # NVIDIA H100 SXM data sheet, at 700 W
    "NVIDIA H100 80GB HBM3": {"fp32_flops": 67e12, "hbm_bytes": 3.35e12},
}
