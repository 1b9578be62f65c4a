"""Host ms of the baseband -> .soft level
(`psk_demod`) per second of air, over the traced run's
window: the host clock around each call's level, ended by a synchronize."""


def read(rec):
    span = rec.get("spans", {}).get("psk_demod")
    return span["s"] * 1e3 / span["air_s"] if span and span["air_s"] else None
