"""The paper's benchmark programs (port of ``repro.isa.programs``)."""
from repro_torch.isa.programs.fft import (digit_reverse_indices, fft_program,
                                          iter_fft_instrs, make_fft_memory,
                                          oracle_spectrum)
from repro_torch.isa.programs.transpose import (iter_transpose_instrs,
                                                transpose_n_threads,
                                                transpose_program)

__all__ = ["transpose_program", "iter_transpose_instrs",
           "transpose_n_threads", "fft_program", "iter_fft_instrs",
           "make_fft_memory", "digit_reverse_indices", "oracle_spectrum"]
