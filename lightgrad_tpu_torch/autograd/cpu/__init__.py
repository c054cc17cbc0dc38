from .tensor import CpuTensor
from . import ops  # registers the numpy op set onto CpuTensor
