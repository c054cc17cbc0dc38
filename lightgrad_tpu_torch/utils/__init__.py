from .fetch import fetch
from .profiler import Profiler, Tracker
