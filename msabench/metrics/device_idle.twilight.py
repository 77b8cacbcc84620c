"""device_idle.twilight (%, device trace): the share of the traced window
in which no kernel or copy ran."""
from msabench import readers


def read(ctx):
    return readers.device_idle(ctx)
