"""95th percentile of how late the load generator sent the window's requests against their due times, in ms."""


def read(ctx):
    return 1e3 * ctx.percentile(ctx.window.lateness_s, 95.0)
