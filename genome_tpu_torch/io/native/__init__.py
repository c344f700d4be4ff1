from genome_tpu_torch.io.native.cio import (NativeUnavailable,
                                            count_fastx_records,
                                            native_available,
                                            parse_fastx_codes)

__all__ = ["NativeUnavailable", "count_fastx_records", "native_available",
           "parse_fastx_codes"]
