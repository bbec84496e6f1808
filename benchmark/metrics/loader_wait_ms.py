"""loader_wait_ms: host milliseconds per step that the training loop spent
waiting in the data loader's __next__ (the benchmark's wrapper around the
batches it hands Trainer.train_epoch)."""


def read(rec):
    waits = rec.get("loader_wait_s")
    if not waits:
        return None
    return 1e3 * sum(waits) / len(waits)
