from .base import BaseModule, DeviceBuffer
from .spmv_module import SpMVModule
from .apply_modules import eWiseAddModule, AssignVectorDenseModule
