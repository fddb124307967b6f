"""Host utilities of the trainer: KPConv's neighbour-limit calibration."""
