from .intersect import Hit, moller_trumbore_soa, trace_brute  # noqa: F401
