"""The port's copy of the TRANSOM core: so far the TCE checkpoint datapath."""
