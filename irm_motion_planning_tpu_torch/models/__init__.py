"""Model pieces: the RKHS basis and the arm."""
