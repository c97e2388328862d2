"""Launch sites for G009's twin."""

from ._build import check, kernels


def good(a, b, n, s):
    err = kernels().crdt_good(a, b, n, s)
    check(err, "crdt_good")


def direct(a, n, e, s):
    check(kernels().crdt_wide(a, n, e, s), "crdt_wide")


def through_lib(a, b, n, s):
    lib = kernels()
    err = lib.crdt_good(a, b, n, s)
    check(err, "crdt_good")


def unchecked(a, b, n, s):
    kernels().crdt_good(a, b, n, s)  # expect: G009


def checked_too_early(a, b, n, s):
    check(0, "none")
    err = kernels().crdt_good(a, b, n, s)  # expect: G009
    return err


def wrong_count(a, b, s):
    err = kernels().crdt_good(a, b, s)  # expect: G009
    check(err, "crdt_good")


def dynamic(name, a):
    err = getattr(kernels(), name)(a)
    check(err, name)


def dynamic_lost(name, a):
    return getattr(kernels(), name)(a)  # expect: G009
