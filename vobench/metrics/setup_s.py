"""Seconds from the start of the process to the first timed frame: the
kernel build (first run of a checkout), the drive (rendered on the first
run, loaded after), the program's set-up and one untimed pass that captures
every graph the window replays."""


def read(ctx):
    return ctx.setup_s
