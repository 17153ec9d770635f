"""Process start to the first timed step: interpreter and imports, the
kernel library, scene ingest, the tree build, the warm-up steps."""


def read(rec):
    return rec.setup_s
