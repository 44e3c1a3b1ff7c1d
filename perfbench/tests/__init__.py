"""CPU tests of the benchmark (the file names start ``test_perfbench_``)."""
