"""Device ms per traced training step or prefill wave of elementwise and
copy kernels. Serves every ``elementwise_ms.<cell kind>`` metric."""
from perfbench.lib.readers import elementwise_ms


def read(ctx):
    return elementwise_ms(ctx)
