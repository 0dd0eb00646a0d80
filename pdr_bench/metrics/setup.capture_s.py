"""Host seconds of the set-up calls that warm up and capture the graphed program."""


def read(ctx):
    return ctx.get("capture_s")
