"""The host's dispatch: kernels launched inside the engine's
``dtx_engine_decode`` ranges of the host window, over the decode steps
those ranges ran (each range is one chunk of ``decode_chunk`` steps)."""


def read(lc):
    per = lc["host"].under_range("dtx_engine_decode")
    steps = len(per) * lc["decode_chunk"]
    launches = sum(len(k) for k in per)
    if not steps or not launches:
        return None
    return launches / steps
