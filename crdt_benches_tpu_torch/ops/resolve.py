"""Token codes of the resolvers' token lists (low two bits of ``tta``)."""

FREE, RUN, TINS = 0, 1, 2
