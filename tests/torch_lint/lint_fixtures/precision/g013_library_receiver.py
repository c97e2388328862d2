"""G013 through the port's resolver: a method called on ``self.X`` that
only ever holds None or a library object (built by a callable imported
from outside the linted tree) links to no package function of the same
name.  JAX's resolver links ``self._prof.start()`` by name to every
``start`` and flags the server ``Relay.start`` builds (``# jax-only:``);
a package object's method stays linked."""

from http.server import ThreadingHTTPServer

from torch.profiler import profile


class Capture:
    def __init__(self):
        self._prof = None
        self._front = None

    def begin(self):
        self._prof = profile()
        self._prof.start()  # the library's start(): no package edge

    def listen(self):
        self._front = Front()
        self._front.bind()  # a package object: linked by name


class Front:
    def bind(self):
        return ThreadingHTTPServer(("127.0.0.1", 0), None)  # expect: G013


class Relay:
    def start(self):
        return ThreadingHTTPServer(("127.0.0.1", 0), None)  # jax-only: G013


def hot_round(cap):  # graftlint: hot-path
    cap.begin()
    cap.listen()
