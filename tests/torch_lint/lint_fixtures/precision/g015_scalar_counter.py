"""G015 on augmented stores in the port: ``self.n += 1`` on an attribute
whose every plain store is immutable (``self.n = 0``) rebinds it, a swap
and legal in a publish point; JAX counts every augmented store as in
place (``# jax-only:``).  ``+=`` on a list attribute extends the
published object in place, and stays a finding."""


class Feed:
    def __init__(self):
        self.n = 0
        self.seen = []

    def publish(self, item) -> None:  # graftlint: publish  # graftlint: thread=worker
        self.n += 1  # jax-only: G015
        self.seen += [item]  # expect: G015

    def read(self) -> int:  # graftlint: thread=hot
        return self.n + len(self.seen)
