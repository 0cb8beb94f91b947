"""The paired row kernels' share of their byte roofline in the traced
window: the bytes their launches need for the indices they were given
(each named row read once and written once, K and V, the indices), over
their summed device time by torch.profiler, against 3.35 TB/s."""
from h100_bench.count import PEAK_BYTES


def read(rec):
    tr = rec["trace"]
    if not tr or not tr["rows_device_s"]:
        return None
    return 100.0 * tr["rows_bytes"] / tr["rows_device_s"] / PEAK_BYTES
