"""Metric meters and trackers of the port."""
from .base_tracker import BaseTracker
from .instance_tracker import InstanceTracker, TrackerSpec
from .meters import APPRXMeter, AverageValueMeter, MAEMeter, MSEMeter, R2Meter

__all__ = [
    "APPRXMeter", "AverageValueMeter", "MAEMeter", "MSEMeter", "R2Meter",
    "BaseTracker", "InstanceTracker", "TrackerSpec",
]
