"""The harness core: cell lookup, the measured window, spans and counters,
the device trace, the frozen yardstick and the result line."""
