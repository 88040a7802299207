"""The general drivers, one a kind of traffic (`kind` in traffic/<mix>.json)."""
