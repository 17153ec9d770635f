"""A cell shrunk for a CPU rehearsal: the program runs its plain twins on
the CPU, so the harness's look for a card is skipped and the rest of a
run is driven as on the card."""

from portbench import harness

CELLS = ("cornell-parity-1024", "sphere100k-rr-1024", "cornell-nee-1024",
         "sphere100k-sun-nee-1024")


def overrides(cell: str) -> dict:
    ov = dict(width=24, height=24, spp_per_step=4, check_pixels=576)
    if cell.startswith("sphere"):
        ov.update(n_lat=24, n_lon=24, spp_per_step=2)
    return ov


def run(cell: str, seed: int = 987654321987, fault=None, steps: int = 3,
        **kw):
    """(result, check lines) of a CPU run of ``steps`` steps."""
    return harness.run(cell, seed, 60.0, False, device="cpu",
                       overrides=overrides(cell), fault=fault,
                       max_steps=steps, **kw)
