"""The benchmark's yardstick: frozen copies of what it measures with, so
that no change to the port can move them.  Each module names its source."""
