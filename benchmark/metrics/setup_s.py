"""setup_s (s, host clock): from the process's start to the end of the
warm-up (imports, weights made on the card, the kernels' libraries built or
loaded, the cell's shapes warmed), after a device synchronize."""


def read(rec):
    return rec.setup_s
