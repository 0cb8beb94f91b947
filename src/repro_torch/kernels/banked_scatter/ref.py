"""Oracle: scatter on the logical table, last writer wins."""
import torch


def last_writers(rows: torch.Tensor, n_rows: int) -> torch.Tensor:
    """(N,) bool: True where update i is the last one naming its row."""
    order = torch.arange(rows.shape[0], device=rows.device)
    last = torch.full((n_rows,), -1, dtype=order.dtype, device=rows.device)
    last.scatter_reduce_(0, rows, order, "amax")
    return last[rows] == order


def banked_scatter_ref(table_logical: torch.Tensor, idx: torch.Tensor,
                       updates: torch.Tensor) -> torch.Tensor:
    """A copy of the table with rows ``idx`` set to ``updates``."""
    keep = last_writers(idx, table_logical.shape[0])
    return table_logical.clone().index_copy_(0, idx[keep], updates[keep])
