"""Host seconds in the TCE save: training stalls from the call to its
return (snapshot to host, cache puts)."""


def read(ctx):
    return ctx.get("save_stall_s")
