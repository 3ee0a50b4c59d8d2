"""Persistence sinks.

The port's copy of ``fdoct_tpu/sinks``: the reference's persistence layer
(SURVEY.md §2): timestamped run directories named
``YYYY-MM-DD_HH_MM_SS-<descr>`` (BscanFFT.cpp:702-725), PNG images gray +
JET-colorized (savematasimage, BscanFFT.cpp:307-327), MATLAB ``.m`` text
dumps / OpenCV-XML FileStorage (savematasdata, BscanFFT.cpp:332-347), raw
``.ocv`` binary Mat dumps (BscanFFTspinjnt.cpp:576-686), the run-parameter
footer appended at exit (BscanFFT.cpp:1929-1954), plus native ``.npz``.
"""

from fdoct_tpu_torch.sinks.run_writer import RunWriter, matlab_matrix

__all__ = ["RunWriter", "matlab_matrix"]
