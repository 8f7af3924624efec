"""Runtime sanitizers of the port (counterpart of ``repro.analysis``).

Only the lock-order sanitizer (:mod:`.runtime`, armed by
``REPRO_SANITIZE=1``) and the graph helpers it uses (:mod:`.graphs`) are
ported; the static linter and the tracer-leak check are not (the latter
is JAX-only).  This ``__init__`` stays empty: the serving stack imports
:mod:`.runtime` on every engine construction.
"""
