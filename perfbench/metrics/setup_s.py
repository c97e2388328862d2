"""``setup_s``: seconds from the process's start to the first timed run
(trace load, the program's engine and its kernel library, update
generation, the warm runs).  Host clock."""


def read(w):
    return w.setup_s
