from . import vec  # noqa: F401
