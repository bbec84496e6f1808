"""train_audio_s_per_s: supervised audio trained in the window over the
window's seconds.  A chunk counts frames_out x frame_subsampling_factor /
100 s; its context frames overlap its neighbours' and do not count."""


def read(rec):
    if not rec.get("steps"):
        return None
    return rec["audio_s"] / rec["window_s"]
