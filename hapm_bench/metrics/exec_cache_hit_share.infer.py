"""Exec-cache hits over lookups in the window (``CnnServer.stats()``'s
``hits`` and ``misses`` before and after it; a miss is a bind on the
request path), in %."""


def read(c):
    lookups = c.hits + c.misses
    return 100.0 * c.hits / lookups if lookups else None
