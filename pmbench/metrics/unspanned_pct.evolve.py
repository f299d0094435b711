"""The share in percent of the window's device busy time launched
outside every top-level span of the program (`init`, `lpt`, `force`,
`kick`, `drift`): the device work no span of the program accounts for
(pmbench/spans.py)."""

from pmbench import spans


def read(ctx):
    return spans.unspanned_pct(ctx)
