"""One module for each entry point of the program that a traffic mix
drives; ``traffic/<mix>.json`` names it under ``entry``."""
