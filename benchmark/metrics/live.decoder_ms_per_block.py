"""Host ms of the first decoder's call per demod block in the window, from
the program's own timing of `LivePipeline.push` (`stats["host_s"]
["decoder"]` over `stats["blocks"]`, differences across the window)."""


def read(rec):
    live = rec.get("live")
    if not live or not live["blocks"]:
        return None
    return live["decoder_s"] / live["blocks"] * 1e3
