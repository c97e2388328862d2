"""G011 fence tags against a ``boundary_syncs`` block: a tag the block
names no surface for is dead-checked like a bare fence, also when none
of its fences crossed (``vacuum``); ``genesis`` only against a streamed
run (the artifact's ``lifecycle.stream``); ``cold`` never.
``artifact.json`` is a drain that did not stream; ``artifact_streamed.json``
one that did, whose genesis fences went uncrossed all the same."""


def hot_loop():  # graftlint: hot-path
    pull_all()
    compact()


def pull_all():  # graftlint: fence
    return 1


def compact():  # graftlint: fence=compact
    return 2


def compact_tail():  # graftlint: fence=compact -- expect: G011
    return 3


def vacuum():  # graftlint: fence=vacuum -- expect: G011
    return 4


def install():  # graftlint: fence=genesis -- expect-streamed: G011
    return 5


def off_drain():  # graftlint: fence=cold
    return 6
