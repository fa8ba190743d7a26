"""Analysis: the port's copy of the runtime concurrency verifier
(``concurrency.py``: traced locks and guarded containers, off by default),
which the shuffle feed's shared state routes through."""
