"""grouped_sums' share of its memory roofline over the window: the least
bytes its calls need (roofline.grouped_sums_bytes) at the card's published
HBM bandwidth, over the kernel's device time in the trace."""
import roofline


def read(r):
    p, gs = r.get("profile"), r.get("grouped_sums")
    if not p or not gs or not gs["calls"]:
        return None
    kernel_s = sum(s for name, s in p["kernels_s"].items()
                   if roofline.GROUPED_SUMS_KERNEL in name)
    if kernel_s <= 0:
        return None
    return 100 * gs["bytes"] / roofline.peaks(r["card"]["kind"])["hbm_bytes_per_s"] / kernel_s
