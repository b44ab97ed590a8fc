"""The benchmark's own yardstick: lookup by name, data, spans, the device
trace, frozen arithmetic (ESS, roofline counts)."""
