"""Clouds, rigid transforms and error metrics."""
from .transforms import RigidTransform
from .cloud import MaskedCloud, pad_cloud
from .metrics import rmse, transform_rmse
