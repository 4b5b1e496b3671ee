"""Mean device time a training step spends in its ``train.optimizer``
span (AdamW: the casts, the clip and the foreach update), between the
span's two events on the card, over the steps outside the profiler."""

from bench.lib import spans


def read(rec, model, mix):
    return spans.mean_device_ms(spans.step_spans(rec, "train.optimizer"))
