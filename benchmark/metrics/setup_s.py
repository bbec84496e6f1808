"""setup_s: seconds from the process's start to the first timed step
(imports, weights, inputs, kernel builds and loads, warm-up)."""


def read(rec):
    return rec.get("setup_s")
