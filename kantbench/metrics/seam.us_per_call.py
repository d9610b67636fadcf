"""Host microseconds per call of the packed seam (scoring._staged_pass):
packing, one copy each way, the launch and the stream sync."""


def read(m):
    if not m["seam_calls"]:
        return None
    return m["seam_s"] / m["seam_calls"] * 1e6
