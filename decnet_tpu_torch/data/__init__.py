"""Host data of the port: the benchmark suites' datasets, the threaded
loader, file I/O without PIL or cv2, and the host detail masks."""
from decnet_tpu_torch.data.datasets import get_dataset, StereoDataset
from decnet_tpu_torch.data.loader import DataLoader, collate
# the host synthetic dataset registers itself as "synthetic"
from decnet_tpu_torch.data import synthetic as _synthetic
