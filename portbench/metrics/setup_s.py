"""setup_s: seconds from process start to the first timed job."""


def read(ctx):
    return ctx["setup_s"]
