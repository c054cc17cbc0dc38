from .profiler import Profiler, Tracker
