"""load_s: host seconds of load_scene (mesh IO, BCs, banded order and
plan, coarse space, initial state), ended by a device synchronise."""


def read(ctx):
    return ctx["host"]["load_s"]
