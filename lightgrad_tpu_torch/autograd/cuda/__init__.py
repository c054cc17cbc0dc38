from .tensor import CudaTensor
from . import ops  # registers the CUDA op set onto CudaTensor
from . import device
