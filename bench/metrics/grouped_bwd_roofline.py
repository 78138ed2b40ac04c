"""The compact products' backward's share of its roofline: the least
time of the dX and dW products the masks define (each group's rows x
in x out, each twice the forward's work; inputs read once, outputs
written once) over the device time of everything launched within
``_GroupedCoreBackward`` (its gathers, products and scatters), in %."""
from benchlib import readers


def read(ctx):
    return readers.scope_roofline_percent(ctx, "_GroupedCoreBackward",
                                          "compact_bwd_s")
