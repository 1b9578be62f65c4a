"""Host ms of the .soft -> .cadu level (the
decoder) per second of air, over the traced run's
window: the host clock around each call's level, ended by a synchronize."""


def read(rec):
    span = rec.get("spans", {}).get("decoder")
    return span["s"] * 1e3 / span["air_s"] if span and span["air_s"] else None
