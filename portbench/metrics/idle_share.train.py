"""% of the traced training window with no device activity."""
from portbench.readers import idle_share


def read(run, trace):
    return idle_share(trace)
