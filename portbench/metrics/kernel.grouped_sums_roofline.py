"""grouped_sums' share of its memory roofline over the window, from the
program's own record: the least bytes of its calls on the card
(op.GroupedSums.min_bytes) at the card's published HBM bandwidth, over
the kernel's device time in the trace."""
import roofline


def read(r):
    p, e = r.get("profile"), r.get("engine") or {}
    if not p or not e.get("op.GroupedSums.min_bytes"):
        return None
    kernel_s = sum(s for name, s in p["kernels_s"].items()
                   if roofline.GROUPED_SUMS_KERNEL in name)
    if kernel_s <= 0:
        return None
    hbm = roofline.peaks(r["card"]["kind"])["hbm_bytes_per_s"]
    return 100 * e["op.GroupedSums.min_bytes"] / hbm / kernel_s
