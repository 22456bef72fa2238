from repro_torch.kernels.pq_adc.ops import (LAUNCHES,  # noqa: F401
                                            pq_adc, pq_adc_batch,
                                            pq_adc_fused_topk,
                                            pq_adc_fused_topk_plain,
                                            pq_adc_topk, pq_adc_topk_batch,
                                            pq_adc_topk_plain, quantize_luts,
                                            reset_launches)
from repro_torch.kernels.pq_adc.ref import (build_luts_ref,  # noqa: F401
                                            pq_adc_batch_ref, pq_adc_ref,
                                            pq_adc_rows_ref)
