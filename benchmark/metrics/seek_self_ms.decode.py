"""The seek loop's own time: ``longform_generate``'s span less its encoder
and decode-loop spans, per seek iteration (window slicing, bucket
compaction, the host fetch, segment retrieval)."""


def read(ctx):
    rec, n = ctx["rec"], ctx["work"]["seek_iterations"]
    own = (rec.total_s("seek_loop") - rec.total_s("encoder")
           - rec.total_s("decode_loop"))
    return 1e3 * own / n if n and rec.total_s("seek_loop") > 0 else None
