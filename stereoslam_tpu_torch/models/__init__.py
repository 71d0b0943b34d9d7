"""Whole-image place descriptors for loop closing."""
