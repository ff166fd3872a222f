"""Bucket occupancy of the seek loop: the rows still decoding over the
rows of the power-of-two buckets decoded (the port's
``seek.active_rows`` and ``seek.bucket_rows`` counters)."""

from benchmark.portspans import per, window


def read(ctx):
    w = window(ctx)
    if w is None or not w.counts.get("seek.active_rows"):
        return None
    return per(100.0 * w.counts["seek.active_rows"],
               w.counts.get("seek.bucket_rows"))
