from .detect import RipplesOptions, ripples_main

__all__ = ["RipplesOptions", "ripples_main"]
