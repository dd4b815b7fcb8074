#!/usr/bin/env python3
"""Emit the oracle harness C++ source to stdout (used by build_oracle.sh)."""
HARNESS = r"""// Oracle harness: expose the reference model's RHS and intermediates via a C ABI
// so Python (ctypes) can generate golden data for the JAX reimplementation tests.
#include <cstring>
#include <cstdio>
#include <cstdlib>
#include <cmath>
#include <map>
#include <string>
#include <vector>
#include <queue>
#include <memory>
#include <fstream>
#include <sstream>
#include <iostream>
#include <iomanip>
#include <limits>
#define private public
#include <cstring>
#include <map>
#include <string>
#include "Model_Data.hpp"
#include "IO.hpp"
#include "f.hpp"
#undef private

/* Globals normally defined in shud.cpp (excluded: needs SUNDIALS). */
double *uYsf; double *uYus; double *uYgw; double *uYriv; double *uYlake;
double *globalY; double timeNow;
int dummy_mode = 0; int global_fflush_mode = 0; int global_implicit_mode = 1;
int global_verbose_mode = 0; int lakeon = 0;

static Model_Data *MD = nullptr;
static FileIn *fin = nullptr;
static FileOut *fout = nullptr;
static std::map<std::string, std::pair<double *, int>> regs;

extern "C" {

int oracle_init(const char *prjname) {
    fin = new FileIn;
    fout = new FileOut;
    char inpath[256];
    snprintf(inpath, sizeof(inpath), "input/%s", prjname);
    fin->setInFilePath(inpath, (char *)prjname);
    fout->setOutFilePath(fin->outpath, fin->projectname);
    MD = new Model_Data(fin, fout);
    MD->loadinput();
    MD->initialize();
    MD->CheckInputData();
    fout->updateFilePath();
    globalY = new double[MD->NumY];
    MD->LoadIC();
    MD->debugData(fout->outpath);

    int ne = MD->NumEle, nr = MD->NumRiv, ns = MD->NumSegmt, nl = MD->NumLake;
    regs["uYsf"] = {uYsf, ne};
    regs["uYus"] = {uYus, ne};
    regs["uYgw"] = {uYgw, ne};
    regs["uYriv"] = {uYriv, nr};
    regs["qEleInfil"] = {MD->qEleInfil, ne};
    regs["qEleExfil"] = {MD->qEleExfil, ne};
    regs["qEleRecharge"] = {MD->qEleRecharge, ne};
    regs["qEleNetPrep"] = {MD->qEleNetPrep, ne};
    regs["qElePrep"] = {MD->qElePrep, ne};
    regs["qEleETP"] = {MD->qEleETP, ne};
    regs["qEleETA"] = {MD->qEleETA, ne};
    regs["qEleE_IC"] = {MD->qEleE_IC, ne};
    regs["qEleTrans"] = {MD->qEleTrans, ne};
    regs["qEleEvapo"] = {MD->qEleEvapo, ne};
    regs["qPotEvap"] = {MD->qPotEvap, ne};
    regs["qPotTran"] = {MD->qPotTran, ne};
    regs["qEs"] = {MD->qEs, ne};
    regs["qEu"] = {MD->qEu, ne};
    regs["qEg"] = {MD->qEg, ne};
    regs["qTu"] = {MD->qTu, ne};
    regs["qTg"] = {MD->qTg, ne};
    regs["yEleIS"] = {MD->yEleIS, ne};
    regs["yEleSnow"] = {MD->yEleSnow, ne};
    regs["yEleSurf"] = {MD->yEleSurf, ne};
    regs["yEleUnsat"] = {MD->yEleUnsat, ne};
    regs["yEleGW"] = {MD->yEleGW, ne};
    regs["yRivStg"] = {MD->yRivStg, nr};
    regs["t_prcp"] = {MD->t_prcp, ne};
    regs["t_temp"] = {MD->t_temp, ne};
    regs["t_rh"] = {MD->t_rh, ne};
    regs["t_wind"] = {MD->t_wind, ne};
    regs["t_rn"] = {MD->t_rn, ne};
    regs["t_lai"] = {MD->t_lai, ne};
    regs["t_mf"] = {MD->t_mf, ne};
    regs["ele_rn_factor"] = {MD->ele_rn_factor, ne};
    regs["ele_rn_h_wm2"] = {MD->ele_rn_h_wm2, ne};
    regs["ele_rn_t_wm2"] = {MD->ele_rn_t_wm2, ne};
    regs["QeleSurfTot"] = {MD->QeleSurfTot, ne};
    regs["QeleSubTot"] = {MD->QeleSubTot, ne};
    regs["Qe2r_Surf"] = {MD->Qe2r_Surf, ne};
    regs["Qe2r_Sub"] = {MD->Qe2r_Sub, ne};
    regs["QsegSurf"] = {MD->QsegSurf, ns};
    regs["QsegSub"] = {MD->QsegSub, ns};
    regs["QrivSurf"] = {MD->QrivSurf, nr};
    regs["QrivSub"] = {MD->QrivSub, nr};
    regs["QrivDown"] = {MD->QrivDown, nr};
    regs["QrivUp"] = {MD->QrivUp, nr};
    regs["fu_Surf"] = {MD->fu_Surf, ne};
    regs["fu_Sub"] = {MD->fu_Sub, ne};
    regs["iBeta"] = {MD->iBeta, ne};
    if (nl > 0) {
        regs["yLakeStg"] = {MD->yLakeStg, nl};
        regs["y2LakeArea"] = {MD->y2LakeArea, nl};
        regs["QLakeSurf"] = {MD->QLakeSurf, nl};
        regs["QLakeSub"] = {MD->QLakeSub, nl};
        regs["QLakeRivIn"] = {MD->QLakeRivIn, nl};
        regs["QLakeRivOut"] = {MD->QLakeRivOut, nl};
        regs["qLakePrcp"] = {MD->qLakePrcp, nl};
        regs["qLakeEvap"] = {MD->qLakeEvap, nl};
    }
    return 0;
}

void oracle_dims(int *ne, int *nr, int *ns, int *nl, int *ny) {
    *ne = MD->NumEle; *nr = MD->NumRiv; *ns = MD->NumSegmt;
    *nl = MD->NumLake; *ny = MD->NumY;
}

void oracle_get_y0(double *out) { memcpy(out, globalY, MD->NumY * sizeof(double)); }

void oracle_get_qele_edges(double *surf, double *sub) {
    for (int i = 0; i < MD->NumEle; i++)
        for (int j = 0; j < 3; j++) {
            surf[i * 3 + j] = MD->QeleSurf[i][j];
            sub[i * 3 + j] = MD->QeleSub[i][j];
        }
}

int oracle_get(const char *name, double *out) {
    auto it = regs.find(name);
    if (it == regs.end()) return -1;
    memcpy(out, it->second.first, it->second.second * sizeof(double));
    return it->second.second;
}

int oracle_set(const char *name, const double *in) {
    auto it = regs.find(name);
    if (it == regs.end()) return -1;
    memcpy(it->second.first, in, it->second.second * sizeof(double));
    return it->second.second;
}

void oracle_update_forcing(double t) {
    MD->updateAllTimeSeries(t);
    MD->updateforcing(t);
}

void oracle_et(double t, double tout) { MD->ET(t, tout); }

void oracle_f(double t, const double *y, double *dy) {
    _generic_N_Vector Y, DY;
    Y.data = const_cast<double *>(y);
    Y.length = MD->NumY;
    DY.data = dy;
    DY.length = MD->NumY;
    f(t, &Y, &DY, MD);
}

double oracle_solar(double t, double lat, double lon, double *az, double *decl) {
    SolarPosition sp = solarPosition(t, lat, lon, MD->Time, 0.0);
    *az = sp.azimuth;
    *decl = sp.declination;
    return sp.cosZ;
}

int oracle_get_ele_field(const char *name, double *out) {
    int ne = MD->NumEle;
    std::string s(name);
    for (int i = 0; i < ne; i++) {
        _Element &E = MD->Ele[i];
        double v = 0;
        if (s == "area") v = E.area;
        else if (s == "x") v = E.x;
        else if (s == "y") v = E.y;
        else if (s == "z_surf") v = E.z_surf;
        else if (s == "z_bottom") v = E.z_bottom;
        else if (s == "AquiferDepth") v = E.AquiferDepth;
        else if (s == "WetlandLevel") v = E.WetlandLevel;
        else if (s == "RootReachLevel") v = E.RootReachLevel;
        else if (s == "MacporeLevel") v = E.MacporeLevel;
        else if (s == "FixPressure") v = E.FixPressure;
        else if (s == "infKsatV") v = E.infKsatV;
        else if (s == "ThetaS") v = E.ThetaS;
        else if (s == "ThetaFC") v = E.ThetaFC;
        else if (s == "ThetaR") v = E.ThetaR;
        else if (s == "Alpha") v = E.Alpha;
        else if (s == "Beta") v = E.Beta;
        else if (s == "hAreaF") v = E.hAreaF;
        else if (s == "macKsatV") v = E.macKsatV;
        else if (s == "infD") v = E.infD;
        else if (s == "KsatH") v = E.KsatH;
        else if (s == "KsatV") v = E.KsatV;
        else if (s == "Sy") v = E.Sy;
        else if (s == "geo_ThetaS") v = E.geo_ThetaS;
        else if (s == "geo_ThetaR") v = E.geo_ThetaR;
        else if (s == "geo_vAreaF") v = E.geo_vAreaF;
        else if (s == "macKsatH") v = E.macKsatH;
        else if (s == "macD") v = E.macD;
        else if (s == "VegFrac") v = E.VegFrac;
        else if (s == "Albedo") v = E.Albedo;
        else if (s == "Rough") v = E.Rough;
        else if (s == "RzD") v = E.RzD;
        else if (s == "nx") v = E.nx;
        else if (s == "ny") v = E.ny;
        else if (s == "nz") v = E.nz;
        else if (s == "slopeAngle") v = E.slopeAngle;
        else if (s == "aspect") v = E.aspect;
        else if (s == "depression") v = E.depression;
        else if (s == "edge0") v = E.edge[0];
        else if (s == "edge1") v = E.edge[1];
        else if (s == "edge2") v = E.edge[2];
        else if (s == "Dist2Edge0") v = E.Dist2Edge[0];
        else if (s == "Dist2Edge1") v = E.Dist2Edge[1];
        else if (s == "Dist2Edge2") v = E.Dist2Edge[2];
        else if (s == "Dist2Nabor0") v = E.Dist2Nabor[0];
        else if (s == "Dist2Nabor1") v = E.Dist2Nabor[1];
        else if (s == "Dist2Nabor2") v = E.Dist2Nabor[2];
        else if (s == "avgRough0") v = E.avgRough[0];
        else if (s == "avgRough1") v = E.avgRough[1];
        else if (s == "avgRough2") v = E.avgRough[2];
        else if (s == "nabr0") v = E.nabr[0];
        else if (s == "nabr1") v = E.nabr[1];
        else if (s == "nabr2") v = E.nabr[2];
        else if (s == "lakenabr0") v = E.lakenabr[0];
        else if (s == "lakenabr1") v = E.lakenabr[1];
        else if (s == "lakenabr2") v = E.lakenabr[2];
        else if (s == "iLake") v = E.iLake;
        else if (s == "iBC") v = E.iBC;
        else if (s == "iSS") v = E.iSS;
        else return -1;
        out[i] = v;
    }
    return ne;
}

int oracle_get_riv_field(const char *name, double *out) {
    int nr = MD->NumRiv;
    std::string s(name);
    for (int i = 0; i < nr; i++) {
        _River &R = MD->Riv[i];
        double v = 0;
        if (s == "down") v = R.down;
        else if (s == "BC") v = R.BC;
        else if (s == "toLake") v = R.toLake;
        else if (s == "Length") v = R.Length;
        else if (s == "BedSlope") v = R.BedSlope;
        else if (s == "depth") v = R.depth;
        else if (s == "bankslope") v = R.bankslope;
        else if (s == "BottomWidth") v = R.BottomWidth;
        else if (s == "Sinuosity") v = R.Sinuosity;
        else if (s == "rivRough") v = R.rivRough;
        else if (s == "Cwr") v = R.Cwr;
        else if (s == "KsatH") v = R.KsatH;
        else if (s == "BedThick") v = R.BedThick;
        else if (s == "avgRough") v = R.avgRough;
        else if (s == "Dist2DownStream") v = R.Dist2DownStream;
        else if (s == "zbank") v = R.zbank;
        else return -1;
        out[i] = v;
    }
    return nr;
}

int oracle_get_seg_field(const char *name, double *out) {
    int ns = MD->NumSegmt;
    std::string s(name);
    for (int i = 0; i < ns; i++) {
        RiverSegement &G = MD->RivSeg[i];
        double v = 0;
        if (s == "iRiv") v = G.iRiv;
        else if (s == "iEle") v = G.iEle;
        else if (s == "length") v = G.length;
        else if (s == "eqDistance") v = G.eqDistance;
        else if (s == "Cwr") v = G.Cwr;
        else if (s == "KsatH") v = G.KsatH;
        else return -1;
        out[i] = v;
    }
    return ns;
}
}

"""
print(HARNESS)
