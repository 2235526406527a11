"""The batch mesh: rows or seeds split over devices in one process."""

from insite_tpu_torch.parallel.mesh import (batch_mesh, gather_rows,
                                            pad_rows, row_mask, seed_blocks,
                                            shard_rows, unpad_rows)

__all__ = ['batch_mesh', 'gather_rows', 'pad_rows', 'row_mask', 'seed_blocks',
           'shard_rows', 'unpad_rows']
