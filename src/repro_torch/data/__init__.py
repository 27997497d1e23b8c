"""The synthetic task suite of the port: copies of the reference's
``src/repro/data/`` modules (they use only numpy and ``random``), so the
same seed gives byte-equal batches in both packages."""
from repro_torch.data.loader import TaskDataset
from repro_torch.data.tasks import TASKS, task_geometry
from repro_torch.data.tokenizer import CharTokenizer

__all__ = ["TaskDataset", "TASKS", "task_geometry", "CharTokenizer"]
