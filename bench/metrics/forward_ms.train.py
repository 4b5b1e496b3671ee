"""Mean device time a training step spends in its ``train.forward`` span
(``loss_fn``, the forward), between the span's two events on the card,
over the steps outside the profiler."""

from bench.lib import spans


def read(rec, model, mix):
    return spans.mean_device_ms(spans.step_spans(rec, "train.forward"))
