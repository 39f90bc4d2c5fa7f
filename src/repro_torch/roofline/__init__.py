from .analysis import (HBM_BW, NIC_BW, NVLINK_BW, PEAK_FLOPS,
                       CollectiveStats, Roofline, collective_stats,
                       kernel_region_traffic, link_of, model_flops_for)

__all__ = ["CollectiveStats", "Roofline", "collective_stats",
           "kernel_region_traffic", "link_of", "model_flops_for",
           "PEAK_FLOPS", "HBM_BW", "NVLINK_BW", "NIC_BW"]
