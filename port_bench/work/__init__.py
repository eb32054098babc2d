"""Operations and bytes of each hand-written kernel: the arithmetic of
its roofline share, one file a kernel."""
