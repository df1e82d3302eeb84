"""eval sub-package of the PyTorch port: host EMD, the sample store and the
turbulence metrics."""

from .emd import emd2_uniform, wasserstein2  # noqa: F401
from .sample_store import SampleStore  # noqa: F401
from .metrics import (  # noqa: F401
    SampleMetricsCollection,
    WassersteinTKE,
    WassersteinMetric,
    MaxMeanTKEPositionMetric,
)
