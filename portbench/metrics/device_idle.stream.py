"""Device: the share of the traced window in which no operation ran on
the card, in % (common.idle_percent)."""
from portbench.common import idle_percent as read  # noqa: F401
