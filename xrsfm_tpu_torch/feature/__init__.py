"""Matching stage of the port: pair selection, descriptor matching and
F-verification."""
