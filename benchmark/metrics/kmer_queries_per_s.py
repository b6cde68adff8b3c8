"""k-mer windows answered in the window (each once, after the strand
merge: the CLI's number_of_queries) over the window's whole wall, from
the first record read to the last line written."""


def read(run):
    return run.n_queries / run.window_s if run.window_s > 0 and run.n_queries else None
