from . import (bresenham, correlation, filters, icp, kabsch, nn,  # noqa: F401
               scan, voxel)
