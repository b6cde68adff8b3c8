"""95th percentile over every chunk of the window of the time from the
chunk's hand-off to merged_pairs_flat_begin to its bytes written."""

import numpy as np


def read(run):
    lat = run.chunk_latency_s
    return float(np.percentile(lat, 95)) * 1e3 if len(lat) else None
