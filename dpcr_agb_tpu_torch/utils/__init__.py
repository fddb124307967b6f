"""Host utilities: KPConv's neighbour-limit calibration and the timing
helpers."""
