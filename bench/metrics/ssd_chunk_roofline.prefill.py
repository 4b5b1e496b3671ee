"""The SSD chunk kernel's share of its roofline over the traced waves'
prefills: the least time of the chunked SSD's per-chunk form at the
configuration's widths, chunk and compute type and the shapes the serve
loop hands the model (bench/lib/work.py), over the device time of the
kernels named here."""

from bench.lib import work

KERNELS = ("ssd_chunk_mixed", "ssd_chunk_bf16", "ssd_chunk_f32")


def read(rec, model, mix):
    tr = getattr(rec, "trace", None)
    if tr is None:
        return None
    secs = tr.kernel_seconds(KERNELS)
    if secs <= 0:
        return None
    least = sum(work.least_time(*work.ssd_chunk_work(
        model, len(w.rids), w.padded_len)) for w in rec.waves if w.traced)
    return 100.0 * least / secs
