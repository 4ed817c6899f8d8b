from .base import BaseModule, DeviceBuffer
from .spmv_module import SpMVModule
from .spmspv_module import SpMSpVModule
from .apply_modules import (eWiseAddModule, AssignVectorDenseModule,
                            AssignVectorSparseModule)
