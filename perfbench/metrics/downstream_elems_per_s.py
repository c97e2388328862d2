"""``downstream_elems_per_s``: trace patches x replicas x whole runs
completed, over the whole window from the first run's start to the last
run's end (host clock).  An element is one patch applied to one replica."""


def read(w):
    return w.runs * w.elements_per_run / w.seconds
