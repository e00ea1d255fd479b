"""device.idle_pct.decode: the share of the traced replayed steps' window
in which no device operation ran, in %."""


def read(record):
    if not record or not record.get("window_s"):
        return None
    return 100.0 * (1.0 - record["busy_s"] / record["window_s"])
