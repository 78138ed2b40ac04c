"""The check that the measured process never loaded the JAX package or
JAX itself: top-level module names are compared whole, so ``repro_torch``
passes and ``repro`` does not."""
import sys

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "repro"})


def forbidden_modules(modules=None) -> list:
    """The loaded modules whose top-level name is forbidden."""
    names = sys.modules if modules is None else modules
    return sorted(n for n in names if n.split(".", 1)[0] in FORBIDDEN)
