"""Roofline share of one ``canny_fused`` call on the cell's B level-0 images
(the last step's), timed alone behind a spin kernel; bytes: the uint8 gray
in and the edges out."""
from vobench import roofline


def read(obs):
    if obs["device"].type != "cuda":
        return None
    from revo_tpu_torch.ops.canny import canny_fused

    pyr = obs["config"]["pyramid"]
    low = min(pyr["canny_threshold1"], pyr["canny_threshold2"])
    high = max(pyr["canny_threshold1"], pyr["canny_threshold2"])
    gray = obs["driver"].kernel_inputs()["gray0"].contiguous()
    seconds = roofline.device_seconds(lambda: canny_fused(gray, low, high))
    return roofline.share(roofline.canny_fused_bytes(*gray.shape), seconds)
