"""Analysis tools of the port (the counterpart of ``repro.analysis``): the
roofline terms on an H100 row (:mod:`.roofline`) and the collective byte
count (:mod:`.comm`, in place of the reference's HLO parser)."""
