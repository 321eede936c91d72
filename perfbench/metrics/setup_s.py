"""setup_s (s, host clock): from the process's start to the window's
opening: imports, the client and its engine (weights drawn and uploaded),
the frame pool, kernel libraries built or loaded, one request of every
shape the mix sends."""


def read(run):
    return run.setup_s
