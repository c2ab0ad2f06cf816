"""The whole train step's share of the card's dense bf16 peak, in percent: the
benchmark's frozen FLOPs an episode (``roofline``) times the untraced
window's episodes a second, over ``roofline.PEAK_BF16_FLOPS``."""


def read(record):
    w, out = record["window"], record["outcome"]
    rate = (out["attempted"] - out["failed"]) / w["seconds"]
    return 100.0 * record["flops_per_episode"] * rate / record["peak_flops"]
