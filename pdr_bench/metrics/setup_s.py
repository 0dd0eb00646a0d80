"""Seconds from process start to the first timed unit."""


def read(ctx):
    return ctx["setup_s"]
