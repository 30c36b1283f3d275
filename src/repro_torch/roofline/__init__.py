from repro_torch.roofline.analysis import HW, RooflineReport, analyze_step

__all__ = ["HW", "RooflineReport", "analyze_step"]
